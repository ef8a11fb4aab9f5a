"""Process meshes and data-parallel helpers (port of the JAX package's
``parallel/mesh.py``).

A mesh here is a ``torch.distributed`` process group with one rank per
device, where JAX holds every device in one process:

- ``make_mesh`` lays the ranks out as a 2D ``(data, model)`` grid by JAX's
  rule (``parallel.mesh.data: -1`` takes every rank left) with JAX's errors;
  ``DeviceMesh.group("data")`` is the rank's group along the data axis (the
  ranks that hold its model shard, one for each block of rows) and
  ``group("model")`` its group along the model axis (the ranks that hold
  the same rows, one for each model shard: tensor parallelism,
  ``parallel/tensor_parallel.py``);
- a batch is split over ``data`` in contiguous blocks of rows, data-axis
  order (``batch_rows``): the ranks of one model group hold the same rows;
  the JAX package lets GSPMD insert the gradient and statistic reductions,
  the port issues them itself (``all_reduce_sum``, ``all_gather_cat``, which
  are autograd-aware), each over the axis it names;
- ZeRO-1 (``zero1_spec``, ``Zero1Optimizer``): each rank keeps and updates
  one slice of every optimiser-state leaf along the leaf's largest dim that
  divides the data axis, then gathers the parameters over the data group
  (adafactor's statistics summed over the slices, as the whole leaf's).

NCCL serves CUDA ranks and gloo CPU ranks. gloo carries only ``all_reduce``
and ``broadcast`` for CUDA tensors: where a collective of CUDA tensors runs
on a gloo group (two ranks sharing one card), ``all_gather_cat`` and the
ring's exchange stage the tensors through the host, for that backend only.

While a batch is split over the ranks, ``rows`` is active: batch norm then
reduces its statistics over the global batch, dropout draws the global
batch's mask and keeps the rank's rows, and ring attention gathers the batch
before it shards the tokens. Ring attention runs only there or under
``same_input`` (every rank holds the same batch): elsewhere the ranks may hold
different tiles or cases, and their tokens must not meet in one ring.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DeviceMesh:
    """The ranks of a job laid out as a ``(data, model)`` grid. ``shape`` is
    ``{"data": d, "model": m}`` as JAX's ``Mesh.shape``; ``devices`` the rank
    grid, ``devices[i, j]`` the rank of data index i and model index j.

    With a model axis of 1 the data axis's group is the default group (no
    group is made). With a model axis > 1 the mesh makes, on every rank and in
    one order, a group for every row of the grid (the model groups) and one for
    every column (the data groups), once per layout: ``dist.new_group`` is a
    collective of the default group, so every rank must build its first mesh
    of a layout at the same point of the program."""

    def __init__(self, devices: np.ndarray):
        self.devices = np.asarray(devices)
        self.shape = dict(zip(AXES, self.devices.shape))
        self._groups = None
        if self.shape["model"] > 1 and world()[1] > 1:
            self._groups = _axis_groups(self.devices)

    def group(self, axis: str = "data"):
        """The rank's process group along ``axis``."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are {AXES}")
        if self.shape["model"] > 1 and self._groups is None:
            raise RuntimeError(f"a {self.shape} mesh needs a process group of its ranks")
        if self._groups is None:
            if axis == "model":
                raise ValueError("the mesh has a model axis of 1: there is no model group")
            return dist.group.WORLD
        d, m = self._position()
        return self._groups[axis][m if axis == "data" else d]

    def _position(self) -> Tuple[int, int]:
        rank, _ = world()
        d, m = np.argwhere(self.devices == rank)[0]
        return int(d), int(m)

    def axis_rank(self, axis: str = "data") -> int:
        """This rank's position along ``axis``."""
        d, m = self._position()
        return d if axis == "data" else m

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape})"


_GROUPS: Dict[Tuple, Dict[str, list]] = {}


def _axis_groups(devices: np.ndarray) -> Dict[str, list]:
    """The groups of a ``(data, model)`` grid: ``"model"`` one per data index
    (a row of the grid), ``"data"`` one per model index (a column), made once
    per layout in the same order on every rank."""
    key = (devices.shape, tuple(int(r) for r in devices.reshape(-1)))
    if key not in _GROUPS:
        rows = [dist.new_group([int(r) for r in row]) for row in devices]
        cols = [dist.new_group([int(r) for r in col]) for col in devices.T]
        _GROUPS[key] = {"model": rows, "data": cols}
    return _GROUPS[key]


def data_shard(config=None) -> Tuple[int, int]:
    """``(data index, data-axis size)`` of this rank in the mesh ``make_mesh``
    lays out for ``config`` over the job's ranks, without making any group:
    how a loader splits the train stream."""
    rank, size = world()
    data, model = _grid(config, size)
    return rank // model, data


def _grid(config, n: int) -> Tuple[int, int]:
    """``(data, model)`` of a mesh of ``n`` devices from ``parallel.mesh``, by
    the JAX package's rule and errors."""
    mesh_cfg: Dict[str, Any] = {}
    if config is not None:
        mc = config.get("parallel.mesh", {}) or {}
        mesh_cfg = mc.to_dict() if hasattr(mc, "to_dict") else dict(mc)
    model = int(mesh_cfg.get("model", 1) or 1)
    data = int(mesh_cfg.get("data", -1) or -1)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices; set parallel.mesh.data: -1")
    return data, model


def make_mesh(config=None, devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """The ``(data, model)`` mesh of ``devices`` (the job's ranks by default)
    from ``parallel.mesh``, by the JAX package's rule and errors."""
    devices = list(devices if devices is not None else range(world()[1]))
    return DeviceMesh(np.asarray(devices).reshape(_grid(config, len(devices))))


def zero1_spec(shape, n_shards: int, axis: str = "data") -> tuple:
    """ZeRO-1 partition spec for one optimiser-state leaf: shard the largest
    dim divisible by ``n_shards``; replicate (``()``) if none divides.
    Deterministic from the shape alone. The JAX package returns the same
    entries as a ``PartitionSpec``."""
    best = None
    for i, d in enumerate(shape):
        if d > 0 and d % n_shards == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _spec_dim(spec: tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def batch_rows(n: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """``(start, count)``: this rank's contiguous block of a batch of ``n``."""
    size = mesh.shape["data"]
    if n % size:
        raise ValueError(f"batch {n} does not divide the mesh data axis ({size})")
    c = n // size
    return mesh.axis_rank("data") * c, c


# -- the rows of a split batch -------------------------------------------------

_ROWS: Optional[Tuple[int, int, int, DeviceMesh]] = None


@contextlib.contextmanager
def rows(start: int, count: int, total: int, mesh: DeviceMesh):
    """Within: the tensors on this rank are rows ``[start, start + count)`` of
    a batch of ``total`` split over ``mesh``'s data axis."""
    global _ROWS
    prev, _ROWS = _ROWS, (int(start), int(count), int(total), mesh)
    try:
        yield
    finally:
        _ROWS = prev


def active_rows() -> Optional[Tuple[int, int, int, DeviceMesh]]:
    """``(start, count, total, mesh)`` while a split batch runs, else None."""
    return _ROWS


_SAME_INPUT = False


@contextlib.contextmanager
def same_input():
    """Within: every rank holds the same tensors (one replicated batch), so
    the ranks may split its tokens among them (ring attention)."""
    global _SAME_INPUT
    prev, _SAME_INPUT = _SAME_INPUT, True
    try:
        yield
    finally:
        _SAME_INPUT = prev


def ranks_share_batch() -> bool:
    """True where the ranks of either axis are known to compute on one
    batch: a split batch (``rows``: the data axis's ranks hold its blocks of
    rows, which a ring over them gathers, and the ranks of a model group
    hold the same rows) or a replicated one (``same_input``)."""
    return _ROWS is not None or _SAME_INPUT


def dropout_rows(x: torch.Tensor, p: float, channel: bool) -> Optional[torch.Tensor]:
    """Dropout of this rank's rows of a split batch as the whole batch would
    draw it in one process (None outside ``rows``): the mask of the global
    batch from the step's generator, its rows kept. ``x`` leads with the
    batch, possibly folded with an inner dim (``B·nW`` windows)."""
    if _ROWS is None:
        return None
    start, count, total, _ = _ROWS
    f = x.shape[0] // count
    if channel:
        shape = (total * f, x.shape[1]) + (1,) * (x.dim() - 2)
        noise = torch.nn.functional.dropout3d(
            torch.ones(shape, dtype=x.dtype, device=x.device), p, True)
    else:
        noise = torch.nn.functional.dropout(
            torch.ones((total * f,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device), p, True)
    return x * noise[start * f:(start + count) * f]


# -- collectives ----------------------------------------------------------------


class PeerFailed(RuntimeError):
    """Work under an :func:`agreement` failed on another rank."""


class Agreement:
    """The ranks of a job settling whether a unit of work (a tuning
    candidate) failed on any of them, by votes (one ``all_reduce(MAX)`` over
    a gloo group of every rank, on the host: no wait for the card) that every
    rank reaches whether or not its own work raised. :func:`collective` votes
    "going on" in front of each collective of the work; a rank whose work
    raised votes "failed" in ``finish`` (once, unless a vote already told
    it), which the others meet at their next vote or at their own
    ``finish``: then every rank knows, and no rank is left in the work's
    collective. Every rank must run the same number of collectives."""

    def __init__(self, group):
        self.group, self.settled = group, False

    def _vote(self, failed: bool, values: Sequence[float]) -> Tuple[bool, List[float]]:
        t = torch.tensor([float(failed), *values], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t[0] > 0), t[1:].tolist()

    def check(self) -> None:
        """Vote "going on"; raise ``PeerFailed`` if a rank voted "failed"."""
        if self._vote(False, (0.0, 0.0))[0]:
            self.settled = True
            raise PeerFailed("the work failed on another rank")

    def finish(self, failed: bool, values: Sequence[float] = (0.0, 0.0)
               ) -> Tuple[bool, List[float]]:
        """The closing vote: whether any rank failed, and each of ``values``'
        largest over the ranks (two floats, the slowest rank's times). A rank
        that a vote already told votes no more."""
        if self.settled:
            return True, [float("nan")] * len(values)
        self.settled = True
        return self._vote(failed, values)


_AGREEMENT: Optional[Agreement] = None


def control_group():
    """A gloo group of every rank, for votes and small objects on the host:
    the default group where it is gloo, else a new one (a collective: every
    rank calls it)."""
    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


@contextlib.contextmanager
def agreement(group=None):
    """Within: every :func:`collective` votes first over ``group`` (from
    :func:`control_group`); yields the :class:`Agreement`, or None outside a
    process group."""
    global _AGREEMENT
    if not (dist.is_available() and dist.is_initialized()):
        yield None
        return
    prev, _AGREEMENT = _AGREEMENT, Agreement(group)
    try:
        yield _AGREEMENT
    finally:
        _AGREEMENT = prev


def collective(op: Callable, *args, **kwargs):
    """``op(*args, **kwargs)``, a collective of ``torch.distributed`` in the
    port's passes (every one of them goes through here); under an
    :func:`agreement`, every rank's vote that its work goes on comes first
    (raises ``PeerFailed`` when a rank's failed)."""
    if _AGREEMENT is not None and not _AGREEMENT.settled:
        _AGREEMENT.check()
    return op(*args, **kwargs)


def _staged(group, x: torch.Tensor) -> bool:
    """gloo moves CUDA tensors only in all_reduce and broadcast."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    size = dist.get_world_size(group)
    if size == 1:
        return [x]
    src = x.detach().contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    collective(dist.all_gather, parts, src, group=group)
    return [t.to(x.device) for t in parts] if staged else parts


class _GatherCat(torch.autograd.Function):
    """``cat`` of every rank's ``x`` along ``dim``; the gradient is the sum of
    every rank's gradient, this rank's block kept."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_world_size(ctx.group) > 1:
            collective(dist.all_reduce, g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def all_gather_cat(x: torch.Tensor, dim: int, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """Every rank's equal-shaped ``x`` joined along ``dim`` in rank order,
    differentiable (the backward sums the ranks' gradients)."""
    return _GatherCat.apply(x, dim, mesh.group(axis))


class _Scatter(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``, of ranks that compute alike;
    the gradient is every rank's block gathered back."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g.contiguous(), ctx.group), dim=ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every rank's block joined along ``dim``, for ranks that compute alike
    after it: each takes its own block of the (equal) gradient, unsummed."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n), None, None


def scatter_alike(x: torch.Tensor, dim: int, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` where the ranks of ``axis``
    compute alike (the same rows and replicated layers: a model group of a
    model that is not split); the backward gathers the blocks' gradients so
    that every rank holds the whole gradient again."""
    return _Scatter.apply(x, dim, mesh.group(axis))


def gather_alike(x: torch.Tensor, dim: int, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The inverse of :func:`scatter_alike`: the ranks' blocks joined along
    ``dim``; the backward keeps this rank's block of a gradient every rank
    computes alike (no sum: that would count it once a rank)."""
    return _Gather.apply(x, dim, mesh.group(axis))


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (the gradient is
    summed over the ranks in turn)."""
    from torch.distributed.nn.functional import all_reduce

    return collective(all_reduce, x, group=mesh.group(axis))


def all_reduce_(tensors: Iterable[torch.Tensor], mesh: DeviceMesh, axis: str = "data") -> None:
    """Sum every tensor over the ranks of ``axis`` in place (``sum_over``)."""
    sum_over(tensors, mesh.group(axis))


def sum_over(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum every tensor over the ranks of ``group`` in place, in one
    collective (one flat buffer per dtype)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(dist.all_reduce, flat, group=group)
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in ts]),
                                                                 ts)])


# -- ZeRO-1 -----------------------------------------------------------------------


class Zero1Optimizer:
    """ZeRO-1 around a ``ChainedOptimizer``: the moments of every parameter
    live only as this rank's slice along ``zero1_spec`` of the parameter's
    shape (the whole tensor where no dim divides the data axis).

    ``step`` slices each parameter and its (already reduced) gradient, runs
    the inner update on the slices and all-gathers the parameters, so every
    rank ends with the same parameters as an unsharded optimiser. An
    elementwise rule (Adam, AdamW, SGD) needs nothing more; adafactor is
    given each slice's :class:`~..train.optim.Part` (the whole leaf's shape,
    the data group's cut, and ``parts``' own cuts of a tensor-parallel
    shard) and sums its statistics over them. Clipping uses the global norm
    it is given. ``make_inner(slices, parts)`` builds the inner optimiser.
    ``state_dict`` gathers the moments into the unsharded optimiser's
    layout (a collective: every rank calls it); ``load_state_dict`` takes that
    layout and keeps the rank's slices."""

    def __init__(self, params: Iterable[torch.nn.Parameter], make_inner: Callable, mesh: DeviceMesh,
                 axis: str = "data", parts: Optional[Sequence] = None):
        from multimodal_organ_segmentation_tpu_torch.train.optim import Part

        self.mesh, self.axis = mesh, axis
        self.full = list(params)
        parts = list(parts) if parts is not None else [None] * len(self.full)
        n = int(mesh.shape[axis])
        self.dims = [_spec_dim(zero1_spec(tuple(p.shape), n, axis), axis) for p in self.full]
        r = mesh.axis_rank(axis)
        group = mesh.group(axis)
        self.shards, self.parts = [], []
        for p, d, part in zip(self.full, self.dims, parts):
            part = part or Part(tuple(p.shape))
            if d is None:
                self.shards.append(p)
            else:
                c = p.shape[d] // n
                self.shards.append(torch.nn.Parameter(p.detach().narrow(d, r * c, c).clone()))
                part = Part(part.shape, part.cuts + ((d, group),))
            self.parts.append(part)
        self.inner = make_inner(self.shards, self.parts)
        self.clip_norm = self.inner.clip_norm

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self) -> List[torch.Tensor]:
        return self.full

    def _slice(self, x: torch.Tensor, d: int) -> torch.Tensor:
        c = x.shape[d] // self.mesh.shape[self.axis]
        return x.narrow(d, self.mesh.axis_rank(self.axis) * c, c)

    def _moment_dim(self, idx: int, key: str, v) -> Optional[int]:
        """The dim of state entry ``key`` of parameter ``idx`` that ZeRO-1
        slices, or None where the entry is whole on every rank."""
        from multimodal_organ_segmentation_tpu_torch.train.optim import moment_dim

        d = self.dims[idx]
        if d is None or not isinstance(v, torch.Tensor):
            return None
        return moment_dim(key, v.dim(), self.parts[idx].shape, d)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        with torch.no_grad():
            for p, s, d in zip(self.full, self.shards, self.dims):
                if d is not None:
                    # the parameters may have been written since the last
                    # gather (a resume's load_state_dict): slice them anew
                    s.copy_(self._slice(p, d))
                    s.grad = None if p.grad is None else self._slice(p.grad, d).contiguous()
        self.inner.step(grad_norm=grad_norm)
        with torch.no_grad():
            for p, s, d in zip(self.full, self.shards, self.dims):
                if d is not None:
                    p.copy_(torch.cat(_all_gather(s, self.mesh.group(self.axis)), dim=d))

    def zero_grad(self) -> None:
        self.inner.zero_grad()
        for p in self.full:
            p.grad = None

    def state_dict(self):
        sd = self.inner.state_dict()
        group = self.mesh.group(self.axis)
        state = {}
        for idx, slot in sd["state"].items():
            out = {}
            for k, v in slot.items():
                d = self._moment_dim(idx, k, v)
                out[k] = v if d is None else torch.cat(_all_gather(v, group), dim=d)
            state[idx] = out
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd) -> None:
        state = {}
        for idx, slot in sd["state"].items():
            idx = int(idx)
            state[idx] = {}
            for k, v in slot.items():
                d = self._moment_dim(idx, k, v)
                state[idx][k] = v if d is None else self._slice(v, d).clone()
        self.inner.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
