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

``from_jax_checkpoint`` maps a JAX training state (the Orbax tree and
``meta.json`` of the JAX package's ``train/checkpoint.py``) onto this
layout, so that a JAX run resumes here.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
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


# -- a JAX training state, resumed here ------------------------------------------------

_MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": ("trace",),
            "adafactor": ("v_row", "v_col", "v")}


def _find_state(node: Any, keys) -> Optional[Mapping]:
    """The first node of a restored optax state (nested dicts, lists and
    Nones) that holds every one of ``keys``."""
    if isinstance(node, Mapping):
        if set(keys) <= set(node):
            return node
        children = list(node.values())
    elif isinstance(node, (list, tuple)):
        children = list(node)
    else:
        return None
    for child in children:
        found = _find_state(child, keys)
        if found is not None:
            return found
    return None


def _rebuild(node: Any, fn, path=()):
    if isinstance(node, Mapping):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in node.items()}
    return fn(path, node)


def _factored_from_jax(name: str, params: Mapping, state: Mapping, convert) -> Dict[str, Dict]:
    """Adafactor's ``v_row`` / ``v_col`` / ``v`` of a flax params tree onto the
    port's parameters: each factored moment is spread back over the axis it
    averages and carried through the weights' layout maps (``convert``),
    with a probe that numbers that axis to find where it lands; the port's
    ``v_row`` is then the moment whose axis lands on the port's largest
    factored axis, ``v_col`` the other (equal sizes may swap them)."""
    from multimodal_organ_segmentation_tpu_torch.train.optim import _factored_dims

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return np.asarray(tree, np.float32)

    def spread(key, index):
        """Each factored leaf's moment ``key`` (None: a probe numbering the
        axis) broadcast over the axis it averages, ``_factored_dims``' entry
        ``index`` (1: the largest, averaged by ``v_row``; 0: ``v_col``'s);
        zeros elsewhere."""
        def fn(path, p):
            shape = np.shape(p)
            dims = _factored_dims(shape)
            if dims is None:
                return np.zeros(shape, np.float32)
            gone = dims[index]
            if key is None:
                axis = [1] * len(shape)
                axis[gone] = shape[gone]
                return np.broadcast_to(np.arange(shape[gone], dtype=np.float32).reshape(axis), shape)
            return np.broadcast_to(np.expand_dims(at(state[key], path), gone), shape)
        return convert(_rebuild(params, fn))

    def landed(probe) -> int:
        return next(a for a in range(probe.dim()) if probe.shape[a] > 1
                    and not torch.equal(probe.narrow(a, 0, 1), probe.narrow(a, 1, 1)))

    whole = convert(_rebuild(params, lambda path, p: at(state["v"], path)
                             if _factored_dims(np.shape(p)) is None
                             else np.zeros(np.shape(p), np.float32)))
    rows, cols, row_axis, col_axis = (spread("v_row", 1), spread("v_col", 0), spread(None, 1),
                                      spread(None, 0))
    out = {}
    for key, v in whole.items():
        dims = _factored_dims(tuple(v.shape))
        if dims is None:
            out[key] = {"v": v}
            continue
        d1, d0 = dims
        by_axis = {landed(row_axis[key]): rows[key], landed(col_axis[key]): cols[key]}
        if set(by_axis) != {d0, d1}:
            raise ValueError(f"{name}: the factored axes of {key} {tuple(v.shape)} land on "
                             f"{sorted(by_axis)}, the port's rule picks {[d1, d0]}")
        out[key] = {"v_row": by_axis[d0].select(d0, 0).contiguous(),
                    "v_col": by_axis[d1].select(d1, 0).contiguous()}
    return out


def from_jax_checkpoint(config, tree: Mapping[str, Any], meta: Optional[Mapping] = None
                        ) -> Dict[str, Any]:
    """A JAX training state (the tree the JAX package's ``save_checkpoint``
    writes and its ``load_checkpoint`` restores, as nested dicts, lists and
    numpy arrays) as the tree ``Trainer.resume`` takes, for ``config`` (the
    run's config: the model and the optimiser to map onto). Returns
    ``{"tree": ..., "meta": ...}``; write it with :func:`save_checkpoint`
    (``scripts/jax_checkpoint_to_torch.py`` does both ends).

    - weights and batch statistics: ``models/convert.py::params_from_jax``,
      any family ``build_model`` builds; EMA weights alike;
    - the step; ``meta`` (``epoch``, ``best_metric``, ``history``,
      ``step_in_epoch``, ``key_counter``) as it is;
    - the optimiser moments leaf by leaf through the same layout maps:
      adam/adamw's ``mu``/``nu`` and count, sgd's momentum trace, and
      adafactor's ``v_row``/``v_col``/``v`` and count onto the port's
      factored axes in torch layout (a SwinUNETR whose blocks are stacked,
      ``scan_blocks``, steps each stack as one adafactor leaf, which the
      port's unrolled blocks cannot hold: refused). Either leading chain
      stage (``clip`` or ``identity``) carries no state.

    The parameter order (the optimiser's indices) is the model's as
    ``build_model(config)`` builds it in this process."""
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.convert import params_from_jax
    from multimodal_organ_segmentation_tpu_torch.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    config = config if isinstance(config, ConfigNode) else ConfigNode(dict(config))
    name = str(config.get("model.name", "swin_unetr")).lower()
    stats = (tree.get("extra") or {}).get("batch_stats")
    params = params_from_jax(name, tree["params"], stats)
    model = build_model(config, device="cpu", train=True)
    names = [n for n, _ in model.named_parameters()]
    want = set(model.state_dict())
    if set(params) != want:
        raise ValueError(f"the JAX checkpoint does not hold this config's {name}: missing "
                         f"{sorted(want - set(params))}, extra {sorted(set(params) - want)}")
    def convert(moments):
        return params_from_jax(name, moments)

    ema = tree.get("ema_params")
    ema = {n: t for n, t in convert(ema).items() if n in names} if ema else None

    opt_name = str(config.get("training.optimizer.name", "adamw")).lower()
    opt_name = opt_name if opt_name in _MOMENTS else "adamw"
    keys = _MOMENTS[opt_name]
    state = _find_state(tree.get("opt_state"), keys)
    if state is None:
        raise ValueError(f"the JAX optimiser state holds no {keys} moments of a {opt_name} "
                         "optimiser: the config's training.optimizer.name must be the run's")
    count = int(np.asarray(state.get("count", 0))) if "count" in state else None
    if opt_name == "adafactor":
        if _find_state(tree["params"], ("blocks",)) is not None:
            raise ValueError("adafactor of a SwinUNETR with scan_blocks: each stacked leaf is one "
                             "adafactor leaf (its statistics span the stage's blocks), which the "
                             "port's unrolled blocks cannot carry")
        moments = _factored_from_jax(name, tree["params"], state, convert)
        slots = {n: {"step": count, **moments[n]} for n in names}
    elif opt_name == "sgd":
        trace = convert(state["trace"])
        slots = {n: {"momentum_buffer": trace[n]} for n in names}
    else:
        mu, nu = convert(state["mu"]), convert(state["nu"])
        slots = {n: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                 for n in names}
    groups = make_optimizer(config, model.parameters()).state_dict()["param_groups"]
    lr = _find_state(tree.get("opt_state"), ("learning_rate",))
    if lr is not None:
        for g in groups:
            g["lr"] = float(np.asarray(lr["learning_rate"]))
    out = {"step": int(np.asarray(tree.get("step", 0))), "params": params,
           "opt_state": {"state": {i: slots[n] for i, n in enumerate(names)},
                         "param_groups": groups},
           "ema_params": ema}
    return {"tree": out, "meta": dict(meta or {})}
