"""Host loader: shuffling, threaded sample loading, batching, device prefetch
(port of the JAX package's ``data/dataloader.py``).

Worker threads decode and transform samples, and a bounded prefetch queue
overlaps host IO with device compute. The transform graph
(``data/transforms.py``) hands samples over as tensors on its device, and
the collate stacks them there; samples that are still numpy arrays are
stacked in numpy. ``device_prefetch`` moves numpy batches to the device
ahead of consumption (pinned host memory, a non-blocking copy on a side
stream) and passes tensors already there through. Also provides the
pad-to-max collate.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def pad_tensors(arrays: List[np.ndarray], pad_value: float = 0.0) -> np.ndarray:
    """Pad variable-size arrays to the elementwise max shape and stack."""
    ndim = arrays[0].ndim
    max_shape = [max(a.shape[i] for a in arrays) for i in range(ndim)]
    out = []
    for a in arrays:
        pad = [(0, m - s) for s, m in zip(a.shape, max_shape)]
        out.append(np.pad(a, pad, constant_values=pad_value))
    return np.stack(out, axis=0)


def _pad_stack(tensors: List[torch.Tensor], pad_value: float = 0.0) -> torch.Tensor:
    """``pad_tensors`` for tensors, on their device."""
    ndim = tensors[0].dim()
    max_shape = [max(t.shape[i] for t in tensors) for i in range(ndim)]
    out = []
    for t in tensors:
        pad = []
        for s, m in reversed(list(zip(t.shape, max_shape))):
            pad += [0, m - s]
        out.append(torch.nn.functional.pad(t, pad, value=pad_value))
    return torch.stack(out)


def collate_fn(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack samples into a batch; pads on shape mismatch. Tensors stack on
    their device (no round trip through the host), numpy arrays in numpy."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, torch.Tensor):
            if len({tuple(v.shape) for v in vals}) == 1:
                batch[key] = torch.stack(vals)
            else:
                batch[key] = _pad_stack(vals)
        elif hasattr(first, "shape") and hasattr(first, "dtype"):
            vals = [np.asarray(v) for v in vals]
            if len({v.shape for v in vals}) == 1:
                batch[key] = np.stack(vals, axis=0)
            else:
                batch[key] = pad_tensors(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Iterable over batches with worker-threaded loading and prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        collate=collate_fn,
        process_shard: Optional[Sequence[int]] = None,
    ):
        """``process_shard=(pid, nproc)`` — multi-host data parallelism:
        every process builds the SAME deterministic global batch order
        (shuffle is keyed by (seed, epoch), not process state), then keeps
        only its contiguous block of each batch's rows. ``batch_size``
        stays the GLOBAL batch size; each host loads 1/nproc of the bytes.
        The contiguous-block split follows the process rank order."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.collate = collate
        self.seed = seed
        self.process_shard = tuple(process_shard) if process_shard else None
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            if not (0 <= pid < nproc):
                raise ValueError(f"bad process_shard {self.process_shard}")
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, epoch: int) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # per-epoch deterministic permutation keyed by (seed, epoch) —
            # stateless, so a preempted run reproduces the exact batch
            # order of the uninterrupted one (step-granular resume)
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            for b in batches:
                if len(b) % nproc != 0:
                    raise ValueError(
                        f"global batch of {len(b)} does not divide over "
                        f"{nproc} processes; use drop_last or a batch size "
                        f"divisible by {nproc}"
                    )
            batches = [
                b[pid * (len(b) // nproc) : (pid + 1) * (len(b) // nproc)]
                for b in batches
            ]
        return batches

    def epoch_iter(
        self, epoch: int, skip_batches: int = 0
    ) -> Iterator[Dict[str, Any]]:
        """Iterate a specific epoch's (deterministic) batch order, skipping
        the first ``skip_batches`` at the index level (no wasted loading)."""
        return self._iterate(self._index_batches(epoch)[skip_batches:], epoch)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self._epoch += 1
        return self._iterate(self._index_batches(self._epoch), self._epoch)

    def _fetch(self, idx: int, epoch: Optional[int]):
        # Route the epoch to Dataset.get_sample so random transforms draw
        # their PRNG key from the stateless (seed, epoch, idx) triple —
        # a resumed (or multi-host sibling) run then reproduces the exact
        # augmentation stream of the uninterrupted one.
        get = getattr(self.dataset, "get_sample", None)
        if get is not None and epoch is not None:
            return get(int(idx), epoch=int(epoch))
        return self.dataset[int(idx)]

    def _iterate(
        self, batches: List[np.ndarray], epoch: Optional[int] = None
    ) -> Iterator[Dict[str, Any]]:

        if self.num_workers == 0:
            for b in batches:
                yield self.collate([self._fetch(int(i), epoch) for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that aborts when the consumer abandoned the
            # iterator (otherwise the producer thread blocks forever)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(
                                lambda i: self._fetch(i, epoch),
                                [int(i) for i in b],
                            )
                        )
                        if not _put(self.collate(samples)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                _put(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            t.join()
        finally:
            stop.set()


def device_prefetch(iterator, device="cuda", size: int = 2):
    """Overlap host batch production with device compute: each batch's
    arrays go to ``device`` as tensors ahead of consumption. For a CUDA
    device the copy is made from pinned memory, non-blocking, on a side
    stream, and the consumer's stream waits on the copy's event before the
    batch is handed over. For the CPU the arrays become tensors in place."""
    import queue as _q
    import threading as _t

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    buf: "_q.Queue" = _q.Queue(maxsize=size)
    sentinel = object()
    stop = _t.Event()
    stream = torch.cuda.Stream(device) if on_cuda else None

    def to_device(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if on_cuda and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)  # no copy for a tensor already there

    def put(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except _q.Full:
                continue
        return False

    def produce():
        try:
            for batch in iterator:
                if on_cuda:
                    with torch.cuda.stream(stream):
                        out = {k: to_device(v) if hasattr(v, "shape") else v
                               for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                else:
                    out = {k: to_device(v) if hasattr(v, "shape") else v
                           for k, v in batch.items()}
                    ready = None
                if not put((out, ready)):
                    return
        except Exception as e:
            put(e)
        finally:
            put(sentinel)

    _t.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = buf.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            out, ready = item
            if ready is not None:
                torch.cuda.current_stream(device).wait_event(ready)
                for v in out.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(torch.cuda.current_stream(device))
            yield out
    finally:
        stop.set()


def get_dataloader(
    config, split: str = "train", transform=None,
    shuffle=None, drop_last=None, device=None,
) -> DataLoader:
    """Loader factory: batch size from the training config; shuffle and
    drop_last default to train-only, overridable per call. Without a
    ``transform`` the split's transform graph runs on ``device``
    (``get_transforms(config, mode=split)``: normalisation, augmentation for
    train, resize; the card when ``device`` is None)."""
    from multimodal_organ_segmentation_tpu_torch.data.dataset import get_dataset
    from multimodal_organ_segmentation_tpu_torch.data.transforms import get_transforms

    if transform is None:
        transform = get_transforms(config, mode=split, device=device)
    dataset = get_dataset(config, split=split, transform=transform)
    is_train = split == "train"
    if shuffle is None:
        shuffle = is_train
    if drop_last is None:
        drop_last = is_train
    return DataLoader(
        dataset,
        batch_size=int(config.get("training.batch_size", 2)),
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=int(config.get("hardware.num_workers", 4)),
        prefetch=int(config.get("hardware.prefetch_depth", 2)),
        seed=int(config.get("experiment.seed", 42)),
    )
