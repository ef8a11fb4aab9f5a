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
- streaming device-side Dice during validation, and native-grid validation
  every ``training.native_val_every`` epochs;
- best/last/every-N and step checkpoints, early stopping, resume;
- ``evaluate_native``: the shape-bucketed sliding-window runner on the
  original grids, postprocess, Dice + HD95 + NSD + ASSD (+ lesion F1, ECE);
- ``predict``: case discovery over ``{input}/{modality}/*.nii[.gz]``,
  sliding-window inference with optional TTA, ensembles, probabilities and
  uncertainty, argmax → ``{case}_pred.nii.gz`` uint8 with the source affine.
  Like the JAX package, predict normalises only with ``inference.normalize:
  true``.

Not ported yet, each raising ``NotImplementedError`` that names its slice:
meshes, ZeRO-1 and multi-process case shards (multi-device slice),
``model.pretrained`` import, TensorBoard and profiler traces.
"""

from __future__ import annotations

import contextlib
import itertools
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
from multimodal_organ_segmentation_tpu_torch.train.metrics import DiceMetric, dice_update
from multimodal_organ_segmentation_tpu_torch.train.optim import (
    ChainedOptimizer,
    LRScheduler,
    global_norm,
    make_optimizer,
    set_learning_rate,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, save_nifti
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


def _select_tree_params(tree: Mapping[str, Any], config) -> Params:
    """The weights inference-like consumers run on: the EMA tree when the
    tree (a state's or a checkpoint's) carries one and
    ``training.ema_eval`` (default true), else the raw params. ONE rule
    shared by eval, freeze, predict and ensembles."""
    if tree.get("ema_params") is not None and bool(config.get("training.ema_eval", True)):
        return tree["ema_params"]
    return tree["params"]


def select_infer_params(state: TrainState, config) -> Params:
    """``_select_tree_params`` of a live state."""
    return _select_tree_params({"params": state.params, "ema_params": state.ema_params}, config)


def _dropout_active(model: nn.Module) -> bool:
    """Any dropout with p > 0: element (``nn.Dropout``) or channel
    (``Dropout3D``, an ``nn.Dropout3d``); every torch dropout derives from
    ``_DropoutNd``."""
    return any(isinstance(m, nn.modules.dropout._DropoutNd) and m.p > 0 for m in model.modules())


def _running_buffers(model: nn.Module) -> List[torch.Tensor]:
    """The buffers a forward pass updates in place and a checkpoint saves:
    the batch norms' running statistics (every persistent floating buffer)."""
    saved = model.state_dict(keep_vars=True)
    return [b for name, b in model.named_buffers() if name in saved and b.is_floating_point()]


def make_train_step(
    model: nn.Module, optimizer: ChainedOptimizer, loss_fn: Callable, accum_steps: int,
    skip_nonfinite: bool = False, ema_decay: Optional[float] = None,
) -> Callable:
    """Build the train step.

    images ``[accum, micro, H, W, D, C]``, labels ``[accum, micro, H, W, D]``.
    ``skip_nonfinite`` drops the update (params, optimiser state, EMA and the
    batch norms' running statistics keep their previous values) when the loss
    or any gradient is non-finite — one bad batch on a long run must not
    poison the Adam moments. The running statistics move during the forward
    passes, so they are copied before the micro-batches and put back (the
    JAX step keeps its old ``state.extra``). The step still advances and
    ``metrics["skipped"]`` reports 1.0 so the host loop can log it; the test
    costs one host sync a step.
    ``ema_decay`` maintains ``state.ema_params`` as an exponential moving
    average of the params (``e ← d·e + (1−d)·p``, initialised to the initial
    params so no debias term is needed).
    ``key`` (a ``torch.Generator`` from a ``KeyStream``, or None) seeds the
    dropout draws of the step's micro-batches; it is read only when the model
    holds an active dropout.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    dropout = _dropout_active(model)
    running = _running_buffers(model) if skip_nonfinite else []

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
        running_before = [b.clone() for b in running]
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
            if not ok:
                with torch.no_grad():
                    for b, before in zip(running, running_before):
                        b.copy_(before)
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
        # in-training native-grid validation (training.native_val_every):
        # loader + bucketed runner built lazily once, reused every cycle
        self._native_val_loader = None
        self._native_val_runner = None

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
        native_every = int(self.config.get("training.native_val_every", 0) or 0)
        monitor = str(self.config.get("training.checkpoint.monitor", "dice") or "dice").lower()
        if monitor == "dice_native" and native_every <= 0:
            raise ValueError(
                "training.checkpoint.monitor=dice_native requires training.native_val_every > 0"
            )
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

                # periodic native-grid validation: the deployed pipeline's
                # Dice (sliding window on original grids + postprocess)
                dice_native = None
                if native_every > 0 and (
                    (epoch + 1) % native_every == 0 or epoch + 1 == self.epochs
                ):
                    dice_native = self._native_val_dice()
                if native_every > 0:
                    # aligned with epochs (None on off-cycle epochs)
                    self.history.setdefault("val_dice_native", []).append(dice_native)

                dt = time.perf_counter() - t0
                if self.logger:
                    native_str = (
                        f" Native Dice: {dice_native:.4f}" if dice_native is not None else ""
                    )
                    self.logger.info(
                        f"Epoch [{epoch + 1}/{self.epochs}] "
                        f"Train Loss: {train_loss:.4f} Val Loss: {val_loss:.4f} "
                        f"Val Dice: {val_dice:.4f}{native_str} LR: {lr:.2e} ({dt:.1f}s)"
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
                if dice_native is not None:
                    rec["val_dice_native"] = _num(dice_native)
                with open(self.output_dir / "metrics.jsonl", "a") as f:
                    f.write(json.dumps(rec) + "\n")

                # best-metric tracking is independent of checkpoint policy
                # (with save_best off, early stopping must still see the best).
                # monitor=dice_native tracks best only on native-val epochs.
                monitored = dice_native if monitor == "dice_native" else val_dice
                if monitored is None:
                    is_best = improved = False
                else:
                    is_best = monitored >= self.best_metric
                    improved = monitored > self.best_metric
                    self.best_metric = max(self.best_metric, monitored)
                self.ckpt.save(
                    self.state.tree(), epoch, monitored if monitored is not None else val_dice,
                    self.best_metric, history=self.history, is_best=is_best,
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
        t_prev = time.perf_counter()
        for batch in it:
            group.append(batch)
            if len(group) < self.accum_steps:
                continue
            t_data = time.perf_counter()
            images, labels = self._stack_accum(group)
            group = []
            self.state, metrics = train_step(
                self.state, images, labels, self.keys.next()
            )
            loss = float(metrics["loss"])
            t_done = time.perf_counter()
            if self.logger:
                # to the log file (DEBUG): wall time since the previous step,
                # of which the wait for the accumulation group's batches
                self.logger.debug(
                    f"step {step_in_epoch + 1}: loss {loss:.4f} wall "
                    f"{(t_done - t_prev) * 1e3:.1f} ms (data wait {(t_data - t_prev) * 1e3:.1f} ms)"
                )
            t_prev = t_done
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

    # -- native-grid evaluation and inference ---------------------------------

    def _predict_fn(self, params: Optional[Params], patches: torch.Tensor) -> torch.Tensor:
        """Logits of ``patches`` in eval mode under ``no_grad``, with
        ``params`` (a name → tensor mapping) standing in for the model's own
        weights, or the model's own when None."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                if params is None:
                    return self.model(patches)
                return functional_call(self.model, dict(params), (patches,))
        finally:
            self.model.train(was_training)

    def _runner(self):
        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
            SlidingWindowRunner,
        )

        sw_cfg = self.config.get("inference.sliding_window", {}) or {}
        return SlidingWindowRunner(
            self._predict_fn,
            roi_size=tuple(sw_cfg.get("roi_size", [96, 96, 96])),
            num_classes=self.num_classes,
            overlap=float(sw_cfg.get("overlap", 0.5)),
            # int or "auto"/"auto:N": the runner resolves auto per bucket
            sw_batch_size=self.config.get("inference.batch_size", 4),
            mode=str(sw_cfg.get("mode", "gaussian")),
        )

    def _inference_members(self) -> List[Optional[Params]]:
        """Weights for inference: None (the model's own, which
        ``freeze_for_inference`` set to this run's inference weights) plus
        one parameter set per ``inference.ensemble`` checkpoint (port
        ``tree.pt`` format), each cast to the dtypes of the model's tensors
        so the serving model runs it as it runs its own. Callers average
        the member softmaxes."""
        members: List[Optional[Params]] = [None]
        ref = {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}
        for path in list(self.config.get("inference.ensemble", []) or []):
            tree = load_checkpoint(path, map_location=self.device)["tree"]
            params = _select_tree_params(tree, self.config)
            members.append({n: t.to(self.device, ref[n].dtype) for n, t in params.items()
                            if n in ref})
        if len(members) > 1 and self.logger:
            self.logger.info(f"Ensembling {len(members)} checkpoints (softmax average)")
        return members

    def _case_shard(self, key: str = "inference.case_shard") -> Optional[Tuple[int, int]]:
        """``(pid, nproc)`` for cohort-level case parallelism in
        :meth:`predict` (``inference.case_shard``) and
        :meth:`evaluate_native` (``evaluation.case_shard``), or None.

        - ``auto`` (default): no shard in one process. A multi-process job
          (``torch.distributed`` with more than one rank) raises: its shards
          come with the multi-device slice.
        - ``[pid, nproc]``: explicit, for fleets of independent workers
          (e.g. a job array of single-card hosts); each predicts
          ``sorted(cases)[pid::nproc]`` and its results stay partial.
        - ``false``: every worker predicts every case.
        """
        val = self.config.get(key, "auto")
        if isinstance(val, (list, tuple)):
            pid, nproc = int(val[0]), int(val[1])
            if not 0 <= pid < nproc:
                raise ValueError(f"bad {key} {list(val)!r}")
            return (pid, nproc) if nproc > 1 else None
        if isinstance(val, bool):
            if not val:
                return None
        else:
            v = str(val).lower()
            if v in ("false", "off", "none", "no", "0", ""):
                return None
            if v not in ("auto", "true", "on", "1"):
                # a typo must not silently drop cases from what the user
                # believed was an unsharded (or differently-sharded) run
                raise ValueError(
                    f"{key}={val!r}: expected 'auto', a [pid, nproc] pair, or a falsy value"
                )
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise _later(f"{key}=auto across {dist.get_world_size()} processes", "multi-device")
        return None

    def _native_val_dice(self) -> Optional[float]:
        """Mean foreground Dice of the deployed pipeline (sliding-window
        inference on the val split's original grids + the configured
        postprocess), computed during training (``training.native_val_every``).
        Unlike :meth:`evaluate_native` it keeps the optimiser moments
        (training goes on afterwards) and scores Dice only."""
        from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config

        if self._native_val_runner is None:
            from multimodal_organ_segmentation_tpu_torch.data.dataloader import get_dataloader
            from multimodal_organ_segmentation_tpu_torch.data.transforms import get_transforms

            try:
                self._native_val_loader = get_dataloader(
                    self.config, split="val",
                    transform=get_transforms(self.config, mode="native", device=self.device),
                )
            except (OSError, ValueError) as e:  # no val CSV / data_root: disable
                if self.logger:
                    self.logger.warning(f"native_val disabled: cannot build val loader ({e})")
                self.config.set("training.native_val_every", 0)
                return None
            self._native_val_runner = self._runner()

        params = self._infer_params() if self.state.ema_params is not None else None
        dm = DiceMetric(self.num_classes)
        for batch in self._native_val_loader:
            images = _on(batch["image"], self.device, torch.float32)
            labels = _on(batch["label"], self.device, torch.int64)
            for b in range(images.shape[0]):
                logits = self._native_val_runner(images[b], params)
                pred = postprocess_from_config(logits.argmax(dim=-1).cpu().numpy(), self.config)
                dm.update(torch.from_numpy(pred[None]).to(self.device), labels[b][None])
        return float(dm.compute()["dice"])

    def evaluate_native(self, loader=None) -> Dict[str, Any]:
        """Native-grid evaluation: sliding-window inference on the ORIGINAL
        volume grids through the shape-bucketed runner, the configured
        postprocess, then streaming per-class Dice, percentile Hausdorff,
        NSD and ASSD (+ lesion detection and ECE when enabled), cohort-wide
        and per case. Enable from the CLI with ``evaluation.sliding_window:
        true``. Leaves the trainer frozen for inference."""
        from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config
        from multimodal_organ_segmentation_tpu_torch.train.metrics import (
            AverageSurfaceDistance,
            CalibrationError,
            HausdorffDistance,
            LesionDetectionMetric,
            SurfaceDice,
        )

        loader = loader if loader is not None else self.val_loader
        if loader is None:
            raise ValueError("evaluate_native requires a loader")
        if self.state is None:
            self.init_state()

        # cohort parallelism (evaluation.case_shard): an explicit [pid, nproc]
        # worker scores cases[pid::nproc] and reports partial metrics
        shard = self._case_shard("evaluation.case_shard")
        runner = self._runner()
        self.freeze_for_inference()  # moments dropped before tile chunks
        members = self._inference_members()
        if len(members) == 1:
            def logits_for(img):
                return runner(img, members[0])
        else:
            # ensemble: summed member softmaxes (argmax is unaffected by the
            # missing 1/N)
            def logits_for(img):
                acc = None
                for v in members:
                    p = torch.softmax(runner(img, v), dim=-1)
                    acc = p if acc is None else acc + p
                return acc

        hd_pct = float(self.config.get("evaluation.hd_percentile", 95))
        nsd_tol = float(self.config.get("evaluation.surface_dice_tolerance_mm", 2.0))
        dice = DiceMetric(self.num_classes)
        hd = HausdorffDistance(percentile=hd_pct)
        nsd = SurfaceDice(self.num_classes, tolerance_mm=nsd_tol)
        assd = AverageSurfaceDistance(self.num_classes)
        # lesion-wise detection (opt-in): evaluation.lesion_metrics is true
        # (all foreground classes) or a list of lesion-like labels
        lesion_cfg = self.config.get("evaluation.lesion_metrics", False)
        lesions = None
        if lesion_cfg:
            lesions = LesionDetectionMetric(
                self.num_classes,
                overlap_threshold=float(
                    self.config.get("evaluation.lesion_overlap_threshold", 0.0)),
                classes=([int(c) for c in lesion_cfg]
                         if isinstance(lesion_cfg, (list, tuple)) else None),
            )
        # voxel-level ECE of the model posterior (pre-postprocess: it scores
        # the softmax confidences, not the cleaned label map)
        ece = None
        if self.config.get("evaluation.calibration", False):
            ece = CalibrationError(n_bins=int(self.config.get("evaluation.calibration_bins", 10)))
        per_case: List[Dict[str, Any]] = []
        n_cases = 0
        g = 0  # global sample counter across batches (shard ownership)
        smooth = 1e-5
        for batch in loader:
            images = _on(batch["image"], self.device, torch.float32)
            labels_dev = _on(batch["label"], self.device, torch.int64)
            labels_np = labels_dev.to(torch.int32).cpu().numpy()
            ids = batch.get("patient_id")
            for b in range(images.shape[0]):
                if shard is not None and g % shard[1] != shard[0]:
                    g += 1
                    continue
                logits = logits_for(images[b])
                case_ece = None
                if ece is not None:
                    # the ensemble returns SUMMED member softmaxes: normalise
                    # to a posterior before scoring confidence
                    probs = (logits / len(members) if len(members) > 1
                             else torch.softmax(logits, dim=-1))
                    case_ece = ece.update(probs, labels_dev[b])
                # score the DEPLOYED pipeline: the inference.postprocess
                # filter predict() applies runs before the metrics
                pred = postprocess_from_config(logits.argmax(dim=-1).cpu().numpy(), self.config)
                label = labels_np[b]
                spacing = None
                affines = batch.get("affine")
                if affines is not None and affines[b] is not None:
                    A = np.asarray(affines[b], dtype=np.float64)
                    if A.shape == (4, 4):
                        # voxel size = column norms of the direction matrix
                        spacing = tuple(np.sqrt((A[:3, :3] ** 2).sum(axis=0)).tolist())
                # streaming aggregates + per-case readouts: the per-case
                # values are the DELTAS of each metric's state, so the
                # EDTs run once per case
                i, u = dice_update(torch.from_numpy(pred[None]).to(self.device),
                                   labels_dev[b][None], self.num_classes)
                i, u = i.double().cpu().numpy(), u.double().cpu().numpy()
                dice.intersection += i
                dice.union += u
                dice.count += 1
                # per case, a class absent from BOTH pred and GT is None,
                # not a vacuous 1.0 that would inflate the case mean
                case_dice = [float((2.0 * ii + smooth) / (uu + smooth)) if uu > 0 else None
                             for ii, uu in zip(i.tolist(), u.tolist())]

                n_hd = len(hd.distances)
                hd.update(pred[None], label[None], spacing=spacing)
                case_hd = float(hd.distances[-1]) if len(hd.distances) > n_hd else None

                # one EDT pair per (case, class), shared by NSD + ASSD
                edt_cache: Dict[Any, Any] = {}
                n_nsd = [len(x) for x in nsd._scores]
                nsd.update(pred[None], label[None], spacing=spacing, distance_cache=edt_cache)
                case_nsd = [float(x[-1]) if len(x) > n0 else None
                            for x, n0 in zip(nsd._scores, n_nsd)]
                seen = [v for v in case_nsd[1:] if v is not None]

                n_assd = [len(x) for x in assd._scores]
                assd.update(pred[None], label[None], spacing=spacing, distance_cache=edt_cache)
                case_assd = [float(x[-1]) if len(x) > n0 else None
                             for x, n0 in zip(assd._scores, n_assd)]
                assd_seen = [v for v in case_assd[1:] if v is not None]

                lesion_row = lesions.update(pred[None], label[None])[0] if lesions else {}
                case_id = (str(ids[b]) if ids is not None and b < len(ids)
                           else f"case_{g:03d}")  # GLOBAL index: unique under sharding
                fg_present = [v for v in case_dice[1:] if v is not None]
                per_case.append({
                    "case": case_id,
                    "dice": float(np.mean(fg_present)) if fg_present else None,
                    "dice_per_class": case_dice,
                    f"hd{hd_pct:g}": case_hd,
                    "surface_dice": float(np.mean(seen)) if seen else None,
                    "surface_dice_per_class": case_nsd,
                    "assd": float(np.mean(assd_seen)) if assd_seen else None,
                    "assd_per_class": case_assd,
                    **lesion_row,
                    **({"ece": case_ece} if ece is not None else {}),
                })
                n_cases += 1
                g += 1

        metrics: Dict[str, Any] = dice.compute()
        hd_m = hd.compute()
        metrics["hd95"] = hd_m.get("hausdorff_distance")
        if "hausdorff_distance_std" in hd_m:
            metrics["hd95_std"] = hd_m["hausdorff_distance_std"]
        metrics.update(nsd.compute())
        metrics.update(assd.compute())
        if lesions is not None:
            metrics.update(lesions.compute())
        if ece is not None:
            metrics.update(ece.compute())
        metrics["num_cases"] = n_cases
        metrics["per_case"] = per_case
        return metrics

    def _discover_cases(self, input_path) -> Dict[str, Dict[str, Path]]:
        """{case_id: {modality: path}} over {input}/{mod.lower()}/*.nii[.gz];
        only cases with every modality are kept."""
        input_path = Path(input_path)
        modalities = list(self.config.get("data.modalities", ["CT", "PET"]))
        cases: Dict[str, Dict[str, Path]] = {}
        for mod in modalities:
            mdir = input_path / mod.lower()
            if not mdir.exists():
                continue
            for p in sorted(list(mdir.glob("*.nii")) + list(mdir.glob("*.nii.gz"))):
                case = p.name.replace(".nii.gz", "").replace(".nii", "")
                cases.setdefault(case, {})[mod] = p
        return {c: mods for c, mods in cases.items() if len(mods) == len(modalities)}

    def predict(self, input_path, output_path) -> List[str]:
        """Sliding-window inference over the discovered cases; saves
        ``{case}_pred.nii.gz`` (uint8, source affine), and with
        ``inference.save_probabilities`` / ``save_uncertainty`` the 4D
        softmax ``{case}_prob.nii.gz`` and the normalised predictive entropy
        ``{case}_unc.nii.gz``. A loader thread decodes the next case while
        the card runs the current one, and a writer thread gzips masks
        behind it. Leaves the trainer frozen for inference."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from multimodal_organ_segmentation_tpu_torch.data.transforms import normalize_from_config
        from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config
        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
            predict_labels,
            predictive_entropy,
        )
        from multimodal_organ_segmentation_tpu_torch.utils.io import load_case_channels

        if self.state is None:
            self.init_state()
        output_path = ensure_dir(output_path)
        tta = bool(self.config.get("inference.tta", False))

        cases = self._discover_cases(input_path)
        # cohort parallelism: disjoint case subsets per worker
        shard = self._case_shard()
        n_total = len(cases)
        if shard is not None:
            pid, nproc = shard
            cases = {k: cases[k] for k in sorted(cases)[pid::nproc]}
        if self.logger:
            msg = f"Found {n_total} cases under {input_path}"
            if shard is not None:
                msg += (f" (case shard {shard[0]}/{shard[1]}: {len(cases)} assigned to this "
                        "worker)")
            self.logger.info(msg)

        self.freeze_for_inference()  # moments dropped before tile chunks
        # checkpoint ensembling (inference.ensemble): member softmaxes averaged
        members = self._inference_members()

        # the runner's logits equal the per-shape sliding window's, so
        # inference.shape_bucketing has nothing to choose here and is ignored
        runner = self._runner()

        is_ensemble = len(members) > 1
        if is_ensemble:
            def run_sw(vol):
                acc = None
                for v in members:
                    p = torch.softmax(runner(vol, v), dim=-1)
                    acc = p if acc is None else acc + p
                return acc / len(members)
        else:
            def run_sw(vol):
                return runner(vol, members[0])

        modalities = list(self.config.get("data.modalities", ["CT", "PET"]))
        normalize = bool(self.config.get("inference.normalize", False))
        save_probs = bool(self.config.get("inference.save_probabilities", False))
        save_unc = bool(self.config.get("inference.save_uncertainty", False))

        def _load_case(case, mods):
            image, affine = load_case_channels(mods, modalities)
            return case, image, affine

        prefetch = max(1, int(self.config.get("hardware.prefetch_depth", 2)))
        loader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sw-load")
        writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sw-write")
        case_iter = iter(cases.items())
        # prime from the SAME iterator the loop advances
        pending = deque(loader.submit(_load_case, c, m)
                        for c, m in itertools.islice(case_iter, prefetch))

        written: List[str] = []
        write_futures = []
        t_start = time.perf_counter()
        try:
            while pending:
                t0 = time.perf_counter()
                case, image_np, affine = pending.popleft().result()
                nxt = next(case_iter, None)
                if nxt is not None:
                    pending.append(loader.submit(_load_case, *nxt))
                t_loaded = time.perf_counter()
                image = torch.from_numpy(image_np)
                if self.device.type == "cuda":
                    image = image.pin_memory()
                image = image.to(self.device, non_blocking=True)
                if normalize:
                    image = normalize_from_config(image, self.config)

                probs_np = unc_np = None
                if save_probs or save_unc:
                    labels_dev, probs_dev = predict_labels(
                        run_sw, image, tta=tta, return_probs=True, already_probs=is_ensemble)
                    if save_unc:
                        unc_np = predictive_entropy(probs_dev).float().cpu().numpy()
                    if save_probs:
                        probs_np = probs_dev.float().cpu().numpy()
                else:
                    labels_dev = predict_labels(run_sw, image, tta=tta)
                pred = postprocess_from_config(labels_dev.cpu().numpy().astype(np.uint8),
                                               self.config)
                out_file = Path(output_path) / f"{case}_pred.nii.gz"
                if self.logger:
                    self.logger.info(
                        f"case {case} {tuple(image_np.shape[:3])}: load wait "
                        f"{(t_loaded - t0) * 1e3:.1f} ms, inference "
                        f"{(time.perf_counter() - t_loaded) * 1e3:.1f} ms")

                def _write(pred=pred, out_file=out_file, affine=affine,
                           probs_np=probs_np, unc_np=unc_np, case=case):
                    save_nifti(pred, out_file, affine=affine)
                    if probs_np is not None:
                        # 4D NIfTI [H, W, D, C] float32 per-class softmax
                        save_nifti(probs_np, Path(output_path) / f"{case}_prob.nii.gz",
                                   affine=affine)
                    if unc_np is not None:
                        # 3D float32 normalised predictive entropy in [0, 1]
                        save_nifti(unc_np, Path(output_path) / f"{case}_unc.nii.gz",
                                   affine=affine)
                    if self.logger:
                        self.logger.info(f"Saved {out_file}")

                # bound the backlog: a disk slower than the card would
                # otherwise queue every pending mask in RAM
                if len(write_futures) >= 2:
                    write_futures.pop(0).result()
                write_futures.append(writer.submit(_write))
                written.append(str(out_file))
            for f in write_futures:
                f.result()  # surface write errors; all masks on disk past here
        finally:
            loader.shutdown(wait=True, cancel_futures=True)
            writer.shutdown(wait=True)
        if self.logger and written:
            total = time.perf_counter() - t_start
            self.logger.info(f"Predicted {len(written)} cases in {total * 1e3:.1f} ms "
                             f"({total * 1e3 / len(written):.1f} ms a case, IO included)")
        return written


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A batch array (a tensor, or numpy from a loader without the
    transform graph) as a tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device, dtype)
