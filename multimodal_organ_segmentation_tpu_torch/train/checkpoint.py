"""Checkpointing with the reference's policy (port of the JAX package's
``train/checkpoint.py``; ``torch.save`` in place of Orbax).

Policy: ``last`` every epoch, ``best`` on val-dice improvement, ``epoch_{N}``
every ``save_every`` epochs, ``last_step`` every ``save_every_steps``
optimiser steps. A checkpoint is a directory holding ``tree.pt`` (the
train-state tree: ``step``, ``params``, ``opt_state``, ``ema_params``) and
``meta.json`` (``epoch``, ``best_metric``, ``history`` and the step-resume
fields ``step_in_epoch`` and ``key_counter``), so the metadata reads without
unpickling anything. Loading is tolerant of a missing or extra EMA tree:
callers inspect ``tree["ema_params"]`` and apply their own policy.

In a job of several ranks every rank holds the same state (a ZeRO-1
optimiser gathers its moments into the unsharded layout when the tree is
taken, on every rank), rank 0 alone writes, and a synchronous save ends at a
barrier of all ranks, so no rank reads a checkpoint before it is on disk.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import world
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, load_json, save_json

TREE_FILE = "tree.pt"


def to_host(tree: Any) -> Any:
    """A copy of a tree of tensors on the host (tensors cloned, containers
    rebuilt), safe to write while training goes on updating the original."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_checkpoint(
    state_tree: Any,
    path,
    epoch: int = 0,
    best_metric: float = 0.0,
    history: Optional[Dict] = None,
    **extra,
) -> None:
    """Save a tree of tensors + metadata under ``path`` (a directory).

    Crash-safe: writes to a sibling temp dir first, then swaps — a kill
    mid-save never destroys the previous checkpoint. In a job of several
    ranks rank 0 writes and every rank waits for it at a barrier.
    """
    rank, size = world()
    try:
        if rank == 0:
            _write_checkpoint(state_tree, path, epoch, best_metric, history, **extra)
    finally:
        if size > 1:
            dist.barrier()


def _write_checkpoint(state_tree, path, epoch: int = 0, best_metric: float = 0.0,
                      history: Optional[Dict] = None, **extra) -> None:
    path = Path(path).resolve()
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    ensure_dir(tmp)
    torch.save(state_tree, tmp / TREE_FILE)
    save_json(
        {"epoch": epoch, "best_metric": best_metric, "history": history or {}, **extra},
        tmp / "meta.json",
    )
    if path.exists():
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old)
    else:
        tmp.rename(path)


def load_checkpoint(path, map_location="cpu") -> Dict[str, Any]:
    """Load a checkpoint directory → {tree, epoch, best_metric, history, meta}.

    Tensors are restored on ``map_location`` (the host by default, whatever
    device wrote them); ``load_state_dict`` re-places them. The tree carries
    ``ema_params`` as it was written (a dict or None) whatever the caller's
    current EMA setting.
    """
    path = Path(path).resolve()
    if not path.exists():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    tree = torch.load(path / TREE_FILE, map_location=map_location, weights_only=True)
    meta = load_json(path / "meta.json") if (path / "meta.json").exists() else {}
    return {
        "tree": tree,
        "epoch": int(meta.get("epoch", 0)),
        "best_metric": float(meta.get("best_metric", 0.0)),
        "history": meta.get("history", {}),
        "meta": meta,  # full metadata incl. step-resume fields
    }


class AsyncCheckpointWriter:
    """One background worker serialising checkpoint writes off the train
    loop.

    The loop pays only the device→host snapshot (the next train step updates
    the state in place, so it must be copied before that); the atomic
    tmp-swap disk write happens on the worker. Pending writes to the SAME
    path coalesce latest-wins — a slow filesystem can never queue an
    unbounded backlog of ``last`` saves — while distinct paths write in
    submission order. Worker errors surface on the next ``submit()`` or on
    ``flush()``."""

    def __init__(self):
        import atexit
        import threading

        self._cond = threading.Condition()
        self._pending: Dict[str, tuple] = {}
        self._order: list = []
        self._busy = False
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="ckpt-writer"
        )
        self._thread.start()
        # the worker is a daemon (it must never wedge interpreter exit on a
        # hung filesystem); drain queued writes at exit instead of dropping
        self._atexit = atexit
        atexit.register(self._drain_at_exit)

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._order and not self._closed:
                    self._cond.wait()
                if self._closed and not self._order:
                    return
                key = self._order.pop(0)
                args, kwargs = self._pending.pop(key)
                self._busy = True
            try:
                _write_checkpoint(*args, **kwargs)
            except BaseException as e:  # surfaced on next submit/flush
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _drain_at_exit(self) -> None:
        try:
            self.flush()
        except Exception:
            pass  # exit path: nothing useful left to do with the error

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def submit(self, state_tree: Any, path, **meta) -> None:
        """Snapshot ``state_tree`` to the host and queue the write (rank 0
        only: the other ranks hold the same state; no barrier)."""
        if world()[0] != 0:
            return
        host = to_host(state_tree)
        key = str(Path(path).resolve())
        with self._cond:
            self._raise_pending()
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if key not in self._pending:
                self._order.append(key)
            self._pending[key] = ((host, path), meta)
            self._cond.notify_all()

    def flush(self) -> None:
        """Block until every queued write has hit disk; re-raise errors."""
        with self._cond:
            while self._order or self._busy:
                self._cond.wait()
            self._raise_pending()

    def close(self) -> None:
        self.flush()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=60)
        try:
            self._atexit.unregister(self._drain_at_exit)
        except Exception:
            pass


class CheckpointPolicy:
    """best/last/every-N saving policy; writes go through ``writer``
    (async, off-loop) when one is provided."""

    def __init__(self, output_dir, config, writer: Optional[AsyncCheckpointWriter] = None):
        ckpt_cfg = config.get("training.checkpoint", {}) or {}
        self.output_dir = ensure_dir(output_dir)
        self.save_best = bool(ckpt_cfg.get("save_best", True))
        self.save_last = bool(ckpt_cfg.get("save_last", True))
        self.save_every = int(ckpt_cfg.get("save_every", 10) or 0)
        self.writer = writer

    def _write(self, state_tree, path, **meta) -> None:
        if self.writer is not None:
            self.writer.submit(state_tree, path, **meta)
        else:
            save_checkpoint(state_tree, path, **meta)

    def save(
        self,
        state_tree: Any,
        epoch: int,
        metric: float,
        best_metric: float,
        history: Optional[Dict] = None,
        is_best: Optional[bool] = None,
    ) -> float:
        """Apply the policy; returns the (possibly updated) best metric.

        ``best_metric`` must already reflect this epoch (callers decide
        improvement); ``is_best`` marks whether this epoch set it.
        """
        if is_best is None:
            is_best = metric >= best_metric
            best_metric = max(best_metric, metric)
        if self.save_last:
            self._write(
                state_tree, self.output_dir / "last", epoch=epoch,
                best_metric=best_metric, history=history,
            )
        if self.save_best and is_best:
            self._write(
                state_tree, self.output_dir / "best", epoch=epoch,
                best_metric=best_metric, history=history,
            )
        if self.save_every and (epoch + 1) % self.save_every == 0:
            self._write(
                state_tree, self.output_dir / f"epoch_{epoch + 1}", epoch=epoch,
                best_metric=best_metric, history=history,
            )
        return best_metric
