"""Tensor parallelism over a mesh's model axis (the port's counterpart of the
JAX package's ``parallel.mesh.constrain_channels``).

The JAX package constrains the channel dim of a few activations to the
``model`` axis (after each Swin stage and patch merge, the UNETR decoder's
inputs, each UNet3D down block) and lets GSPMD partition the matmuls and
convolutions around them. In the port each rank is one device, so the split
is written out, Megatron style, on the ranks of ``mesh.group("model")``:

- a column-parallel layer holds its rank's rows of the output features (q,
  k and v each split by heads; an MLP's hidden units; a conv's output
  channels) and takes the whole input through ``copy_in``: identity forward,
  its gradient summed over the model group;
- the row-parallel layer after it holds the matching input features, and its
  partial products are summed over the model group by ``reduce_out``
  (all-reduce forward, identity backward) before the bias is added;
- everything between the two is per head or per channel, so it runs on the
  rank's share: kernel A on the rank's heads with their rows of the
  relative-position bias, kernel B on the fusion's heads, instance and batch
  norm per channel (batch norm's sums still reduced over the data group),
  group norm on whole groups, dropout on the slice of the mask the whole
  activation draws;
- everything else (layer norms, patch merges, the encoders, the heads) is
  replicated: every rank of the model group computes it alike, on the same
  inputs, and its gradients agree across the group.

``tp_plan(model, m)`` lists, layer by layer, which parameters are split on
which dim and which layers stay replicated and why. A layer whose heads or
channels do not divide by ``m``, or whose group norm would cut a group,
stays replicated: the flagship's stage 0 has 3 heads, so at ``m = 2`` its
attention runs whole on each rank while its MLP (192 hidden units) splits.
``parallelize(model, mesh)`` slices a model built whole (every rank draws
the same initial weights) to its rank's shard by that plan;
``models/convert.py::shard_state_dict`` and ``gather_state_dict`` carry full
state dicts across. Only the families the JAX package passes ``tp_axis`` to
(SwinUNETR and UNet3D) list targets: another model under a model axis > 1 is
replicated over it, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from multimodal_organ_segmentation_tpu_torch.train.optim import Part, moment_dim


@dataclass(frozen=True)
class Split:
    """How one tensor is cut over ``m`` ranks: along ``dim``, which holds
    ``parts`` equal blocks (q, k and v of a fused projection), each cut into
    ``m`` contiguous pieces; a rank holds its piece of every block."""

    dim: int
    parts: int = 1

    def shard(self, t: torch.Tensor, m: int, r: int) -> torch.Tensor:
        blocks = t.chunk(self.parts, self.dim)
        pieces = [b.narrow(self.dim, r * (b.shape[self.dim] // m), b.shape[self.dim] // m)
                  for b in blocks]
        return torch.cat(pieces, self.dim) if self.parts > 1 else pieces[0]

    def gather(self, shards: List[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's shard, in rank order."""
        per = [s.chunk(self.parts, self.dim) for s in shards]
        return torch.cat([p[b] for b in range(self.parts) for p in per], self.dim)


@dataclass
class LayerPlan:
    """One target layer: ``module`` its dotted path, ``kind`` what splits
    (``heads``, ``mlp``, ``channels``), ``params`` each split tensor (a path
    under the module) with its ``Split`` (empty when replicated), ``local``
    the attributes the shard takes (head or group counts), ``reason`` why it
    is split or replicated."""

    module: str
    kind: str
    params: Dict[str, Split] = field(default_factory=dict)
    local: Dict[str, int] = field(default_factory=dict)
    reason: str = ""

    @property
    def split(self) -> bool:
        return bool(self.params)


@dataclass
class TPPlan:
    m: int
    layers: List[LayerPlan]

    @property
    def splits(self) -> Dict[str, Split]:
        """Every split tensor by its state-dict name."""
        return {f"{lp.module}.{name}": s for lp in self.layers for name, s in lp.params.items()}

    def replicated(self) -> Dict[str, str]:
        """The target layers left whole, each with its reason."""
        return {f"{lp.module} ({lp.kind})": lp.reason for lp in self.layers if not lp.split}

    def describe(self) -> List[str]:
        return [f"{lp.module} ({lp.kind}): {'split' if lp.split else 'replicated'}, {lp.reason}"
                for lp in self.layers]


class TP:
    """The model group a split layer reduces over: ``size`` ranks, this one
    ``rank``."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.group(axis)
        self.size = int(mesh.shape[axis])
        self.rank = mesh.axis_rank(axis)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor of x's dtype. bf16 and
    f16 are summed in f32 and rounded once (as the whole layer's product
    accumulates in f32), which also suits gloo, whose CUDA reductions go
    through the host."""
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import collective

    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    y = x.detach().to(wide, copy=True).contiguous()
    collective(dist.all_reduce, y, group=group)
    return y.to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The whole input of a column-parallel layer: identity, the gradient
    summed over the model group."""
    return _CopyIn.apply(x, tp.group)


def reduce_out(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of a row-parallel layer's partial products over the model
    group; the gradient passes through."""
    return _ReduceOut.apply(x, tp.group)


# -- the rules -------------------------------------------------------------------

def heads_rule(module: str, heads: int, m: int, params: Dict[str, Split]) -> LayerPlan:
    """An attention split by heads, or replicated when they do not divide."""
    if heads % m:
        return LayerPlan(module, "heads", reason=f"{heads} heads do not divide by {m}")
    return LayerPlan(module, "heads", params, {"num_heads": heads // m},
                     f"{heads // m} of {heads} heads a rank")


def hidden_rule(module: str, hidden: int, m: int, params: Dict[str, Split]) -> LayerPlan:
    if hidden % m:
        return LayerPlan(module, "mlp", reason=f"{hidden} hidden units do not divide by {m}")
    return LayerPlan(module, "mlp", params, {}, f"{hidden // m} of {hidden} hidden units a rank")


def channels_rule(module: str, channels: int, norm: str, m: int,
                  params: Dict[str, Split], groups: int = 8) -> LayerPlan:
    """A conv pair split by the first conv's output channels. A group norm
    between them splits only when each rank holds whole groups."""
    if channels % m:
        return LayerPlan(module, "channels", reason=f"{channels} channels do not divide by {m}")
    if norm == "group" and groups % m:
        return LayerPlan(module, "channels",
                         reason=f"group norm's {groups} groups do not divide by {m}: a group "
                                "would span two ranks")
    local = {"groups": groups // m} if norm == "group" else {}
    return LayerPlan(module, "channels", params, local,
                     f"{channels // m} of {channels} channels a rank"
                     + (f", {groups // m} of {groups} groups" if norm == "group" else ""))


def tp_plan(model: nn.Module, m: int) -> TPPlan:
    """The split of ``model``'s target layers over ``m`` model ranks. The
    model lists its targets (``tp_targets``, paths of modules that have a
    ``tp_rule``); a model that lists none is replicated whole. Read from a
    model built whole, or from a shard (its layers keep their whole sizes)."""
    layers: List[LayerPlan] = []
    targets = model.tp_targets() if hasattr(model, "tp_targets") else []
    for path in targets:
        layers.extend(model.get_submodule(path).tp_rule(path, m))
    return TPPlan(int(m), layers)


def _set_tensor(model: nn.Module, name: str, value: torch.Tensor) -> None:
    mod_path, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_path)
    if leaf in mod._parameters:
        old = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(value, requires_grad=old.requires_grad)
    else:
        mod._buffers[leaf] = value


def parallelize(model: nn.Module, mesh, axis: str = "model") -> Optional[TPPlan]:
    """Slice ``model`` (built whole, the same weights on every rank) to this
    rank's shard along ``mesh``'s ``axis`` by ``tp_plan``, in place, before
    any optimiser holds its parameters. Sets ``model.tp`` and
    ``model.tp_plan``; None (and nothing changed) for a model axis of 1."""
    if int(mesh.shape[axis]) == 1:
        return None
    tp = TP(mesh, axis)
    plan = tp_plan(model, tp.size)
    state = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, s in plan.splits.items():
            _set_tensor(model, name, s.shard(state[name].detach(), tp.size, tp.rank).clone())
    for lp in plan.layers:
        if lp.split:
            model.get_submodule(lp.module).tp_apply(tp, lp)
    model.tp, model.tp_plan = tp, plan
    return plan


def model_tp(model: nn.Module) -> Optional[TP]:
    """The model group of a parallelized model, else None."""
    return getattr(model, "tp", None)


def global_norm(grads: List[torch.Tensor], split: List[bool], tp: TP) -> torch.Tensor:
    """The whole model's gradient norm from a rank's shard: the squares of the
    split leaves summed over the model group, each replicated leaf counted
    once (every rank of the group holds the same replicated gradients). Each
    rank then clips and skips by the same norm."""
    def sq(gs):
        if not gs:
            return torch.zeros((), dtype=torch.float32, device=grads[0].device)
        norms = torch._foreach_norm([g.float() if g.dtype != torch.float64 else g for g in gs])
        return torch.linalg.vector_norm(torch.stack(norms)).square()

    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import collective

    own = sq([g for g, s in zip(grads, split) if s]).float()
    collective(dist.all_reduce, own, group=tp.group)
    return torch.sqrt(own + sq([g for g, s in zip(grads, split) if not s]).float())


def whole_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's whole shape by name: a split one's with its dim
    times the model axis, the rest as they are."""
    tp = model_tp(model)
    splits = model.tp_plan.splits if tp is not None else {}
    out = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        if name in splits:
            shape[splits[name].dim] *= tp.size
        out[name] = tuple(shape)
    return out


def leaf_parts(model: nn.Module) -> List[Optional[Part]]:
    """One entry a parameter, in ``model.parameters()`` order: a split
    parameter's :class:`Part` (its whole shape, cut along its split dim over
    the model group), None for one held whole."""
    tp = model_tp(model)
    if tp is None:
        return [None for _ in model.parameters()]
    splits, shapes = model.tp_plan.splits, whole_shapes(model)
    return [Part(shapes[n], ((splits[n].dim, tp.group),)) if n in splits else None
            for n, _ in model.named_parameters()]


def _opt_tensors(sd, names: List[str], plan: TPPlan, shapes: Dict[str, Tuple[int, ...]],
                 fn) -> dict:
    """``fn(split, v)`` on every state tensor that runs along its parameter's
    split dim, with the ``Split`` moved to where that dim sits in the entry
    (adafactor's factored moments drop an axis; one averaged over the split
    dim is whole on every rank)."""
    splits = plan.splits
    state = {}
    for idx, slot in sd["state"].items():
        name = names[int(idx)]
        split = splits.get(name)
        state[idx] = {}
        for k, v in slot.items():
            d = (moment_dim(k, v.dim(), shapes[name], split.dim)
                 if split is not None and isinstance(v, torch.Tensor) else None)
            state[idx][k] = v if d is None else fn(Split(d, split.parts), v)
    return {"state": state, "param_groups": sd["param_groups"]}


def gather_opt_state(sd, names: List[str], plan: TPPlan, shapes: Dict[str, Tuple[int, ...]],
                     mesh) -> dict:
    """An optimiser state dict of a shard (moments by parameter index,
    ``names[i]`` the parameter's state-dict name, ``shapes`` the whole
    parameters' shapes by name) in the whole model's layout, gathered over
    the model group (a collective)."""
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import _all_gather

    group = mesh.group("model")
    return _opt_tensors(sd, names, plan, shapes, lambda s, v: s.gather(_all_gather(v, group)))


def shard_opt_state(sd, names: List[str], plan: TPPlan, shapes: Dict[str, Tuple[int, ...]],
                    rank: int) -> dict:
    """The inverse of :func:`gather_opt_state` for model index ``rank``."""
    return _opt_tensors(sd, names, plan, shapes, lambda s, v: s.shard(v, plan.m, rank).clone())
