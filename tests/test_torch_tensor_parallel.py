"""The port's tensor-parallel plan and weight shards, in one process.

``parallel/tensor_parallel.py::tp_plan`` says which layers split over the
model axis and why the others stay whole; these tests hold it to the
flagship's and ``configs/unet3d_ct_64.yaml``'s shapes (built on the meta
device: no weights are drawn), check that ``models/convert.py``'s
``shard_state_dict`` and ``gather_state_dict`` invert each other bit for bit,
that ``parallelize`` slices a model to exactly the plan's shapes (a
stand-in mesh gives the model index: slicing needs no collective), and that
a split activation's dropout draws its slice of the whole mask. The
numerics of the split forward and train step against the JAX model run in
the spawned process groups of ``tests/test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch

from multimodal_organ_segmentation_tpu_torch.models.build import build_model, get_model
from multimodal_organ_segmentation_tpu_torch.models.convert import (
    gather_state_dict,
    shard_state_dict,
)
from multimodal_organ_segmentation_tpu_torch.parallel import mesh as tmesh
from multimodal_organ_segmentation_tpu_torch.parallel.tensor_parallel import (
    Split,
    parallelize,
    tp_plan,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode, load_config
from tests.torch_port_utils import _one_thread  # noqa: F401

FLAGSHIP = "configs/swin_unetr_xattn_flagship.yaml"
UNET = "configs/unet3d_ct_64.yaml"


def _meta_model(path):
    cfg = load_config(path)
    with torch.device("meta"):
        return get_model(str(cfg.get("model.name")))(cfg)


def _tiny(name, norm="instance"):
    if name == "swin_unetr":
        model = {"name": "swin_unetr", "in_channels": 2, "out_channels": 4,
                 "backbone": {"img_size": [32, 32, 32], "feature_size": 12,
                              "depths": [1, 1, 1, 1], "num_heads": [3, 2, 4, 4],
                              "window_size": [4, 4, 4]},
                 "fusion": {"type": "cross_attention", "stages": [2, 3]}}
    else:
        model = {"name": "unet3d", "in_channels": 2, "out_channels": 4,
                 "backbone": {"features": [8, 24, 48], "norm": norm}}
    return {"experiment": {"seed": 0}, "data": {"modalities": ["CT", "PET"]}, "model": model,
            "hardware": {"mixed_precision": "fp32"}}


class _Mesh:
    """A stand-in mesh: the shape and this rank's indices, no groups."""

    def __init__(self, m, r):
        self.shape, self._r = {"data": 1, "model": m}, r

    def group(self, axis):
        return None

    def axis_rank(self, axis):
        return self._r if axis == "model" else 0


@pytest.mark.parametrize("m", [2, 4])
def test_plan_of_the_flagship(m):
    """fs 48, heads 3-6-12-24, fusion at /8, /16, /32 (2, 4, 8 heads): every
    MLP and the decoders' fs·{8,4,2,1} channels split; an attention whose
    heads do not divide by m stays whole, and the plan says so."""
    plan = tp_plan(_meta_model(FLAGSHIP), m)
    kinds = {(lp.module, lp.kind): lp for lp in plan.layers}
    assert len(plan.layers) == 8 * 2 + 3 + 4
    heads = {0: 3, 1: 6, 2: 12, 3: 24}
    for s, h in heads.items():
        for b in range(2):
            attn = kinds[(f"stage{s}_block{b}.attn", "heads")]
            assert attn.split == (h % m == 0), attn
            if attn.split:
                assert attn.local == {"num_heads": h // m}
                assert set(attn.params) == {"qkv.weight", "qkv.bias", "rel_pos_bias",
                                            "proj.weight"}
                assert attn.params["qkv.weight"] == Split(0, 3)
            else:
                assert attn.reason == f"{h} heads do not divide by {m}"
            mlp = kinds[(f"stage{s}_block{b}", "mlp")]
            assert mlp.split and mlp.reason == f"{4 * 48 * 2 ** s // m} of {4 * 48 * 2 ** s} " \
                                               "hidden units a rank"
    for s, h in {1: 2, 2: 4, 3: 8}.items():
        fusion = kinds[(f"xfuse{s}", "heads")]
        assert fusion.split == (h % m == 0)
        assert fusion.params == ({} if h % m else {
            **{f"{p}.{t}": Split(0) for p in ("q_proj", "k_proj", "v_proj")
               for t in ("weight", "bias")}, "out_proj.weight": Split(1)})
    for d, c in {5: 384, 4: 192, 3: 96, 2: 48}.items():
        dec = kinds[(f"decoder{d}.res", "channels")]
        assert dec.split and dec.reason == f"{c // m} of {c} channels a rank"
        assert set(dec.params) == {"conv1.weight", "conv1.bias", "conv2.weight"}
    replicated = plan.replicated()
    want = {f"stage0_block{b}.attn (heads)" for b in range(2)}
    if m == 4:
        want |= {f"stage1_block{b}.attn (heads)" for b in range(2)} | {"xfuse1 (heads)"}
    assert set(replicated) == want


@pytest.mark.parametrize("m", [2, 4])
def test_plan_of_unet3d_ct_64(m):
    """features 32-64-128-256, instance norm: the conv block of every down
    block splits its channels (the outputs JAX constrains); nothing else is
    a target."""
    plan = tp_plan(_meta_model(UNET), m)
    assert [lp.module for lp in plan.layers] == ["down0.block", "down1.block", "down2.block"]
    for lp, c in zip(plan.layers, (64, 128, 256)):
        assert lp.split and lp.reason == f"{c // m} of {c} channels a rank" and lp.local == {}
        assert lp.params == {"conv1.weight": Split(0), "conv1.bias": Split(0),
                             "conv2.weight": Split(1)}


def test_group_norm_keeps_whole_groups():
    """Group norm's 8 groups: at m = 2 each rank holds 4 whole groups (the
    norm's scale and bias split with them); at m = 3 a group would span two
    ranks, and the block stays whole. Batch norm's running statistics split
    with the channels."""
    model = build_model(_tiny("unet3d", "group"), device="cpu")
    plan = tp_plan(model, 2)
    assert all(lp.split and lp.local == {"groups": 4} for lp in plan.layers)
    assert plan.splits["down0.block.norm1.weight"] == Split(0)
    three = tp_plan(model, 3)
    assert all(not lp.split for lp in three.layers)
    assert three.layers[0].reason == "group norm's 8 groups do not divide by 3: a group " \
                                     "would span two ranks"
    bn = tp_plan(build_model(_tiny("unet3d", "batch"), device="cpu"), 2)
    assert {"down1.block.norm1.running_mean", "down1.block.norm1.running_var"} <= set(bn.splits)


@pytest.mark.parametrize("name", ["swin_unetr", "unet3d"])
def test_shards_gather_back_bit_for_bit(name):
    """``gather_state_dict`` of every rank's ``shard_state_dict`` is the
    state dict, bit for bit; the fused qkv's shard holds, for q, k and v, the
    rows of the rank's heads."""
    model = build_model(_tiny(name), device="cpu", generator=torch.Generator().manual_seed(5))
    sd = model.state_dict()
    for m in (2, 4) if name == "unet3d" else (2,):
        plan = tp_plan(model, m)
        shards = [shard_state_dict(sd, plan, r) for r in range(m)]
        back = gather_state_dict(shards, plan)
        assert list(back) == list(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        for k in plan.splits:
            assert shards[0][k].shape != sd[k].shape, k
    if name == "swin_unetr":
        w = sd["stage1_block0.attn.qkv.weight"]  # 2 heads of 12: [3·24, 24]
        shard = shard_state_dict(sd, tp_plan(model, 2), 1)["stage1_block0.attn.qkv.weight"]
        want = torch.cat([w[12:24], w[36:48], w[60:72]])  # q, k, v of head 1
        assert torch.equal(shard, want)


def test_parallelize_slices_to_the_plan():
    """``parallelize`` on a stand-in mesh: each rank's parameters are its
    ``shard_state_dict`` of the whole model's, the split layers take their
    share of the heads and the rows of the relative-position bias, the
    replicated ones keep theirs, and the split layers' parameter count a
    rank is the plan's (the whole count over m)."""
    cfg = _tiny("swin_unetr")
    whole = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    sd = whole.state_dict()
    plan = tp_plan(whole, 2)
    for r in range(2):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
        got = parallelize(model, _Mesh(2, r))
        assert got.describe() == plan.describe()
        want = shard_state_dict(sd, plan, r)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
        assert model.stage1_block0.attn.num_heads == 1 and model.stage0_block0.attn.num_heads == 3
        assert model.xfuse3.num_heads == 1 and model.stage1_block0.attn.bias(64).shape[0] == 1
        assert model.stage0_block0.drop.tp_slice == (-1, 2, r)
        split = sum(v.numel() for k, v in model.state_dict().items() if k in plan.splits)
        assert split * 2 == sum(sd[k].numel() for k in plan.splits)
        # the plan read back from a shard is the whole model's
        assert tp_plan(model, 2).describe() == plan.describe()


def test_tensor_parallel_configs_build_in_one_process():
    """``parallel.mesh.model: 2`` builds SwinUNETR and UNet3D (it raised
    before): in one process the model is whole, as the JAX model runs
    unconstrained outside a mesh. A family the JAX package gives no
    ``tp_axis`` (the DualEncoder) lists no target: replicated whole."""
    for name in ("swin_unetr", "unet3d"):
        cfg = {**_tiny(name), "parallel": {"mesh": {"data": -1, "model": 2}}}
        model = build_model(ConfigNode(cfg), device="cpu")
        plain = build_model(_tiny(name), device="cpu")
        assert getattr(model, "tp", None) is None
        for k, v in plain.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
    de = {"experiment": {"seed": 0}, "data": {"modalities": ["CT", "PET"]},
          "model": {"name": "dual_encoder", "out_channels": 4,
                    "backbone": {"features": [4, 8], "img_size": [8, 8, 8]}},
          "hardware": {"mixed_precision": "fp32"}}
    assert tp_plan(build_model(de, device="cpu"), 2).layers == []


def test_data_shard_follows_the_data_axis(monkeypatch):
    """The train loader's shard is the rank's data index: on a 2 × 2 grid
    ranks 0 and 1 load rows 0, ranks 2 and 3 rows 1 (a model group holds
    the same rows), with no group made."""
    cfg = ConfigNode({"parallel": {"mesh": {"data": -1, "model": 2}}})
    got = []
    for rank in range(4):
        monkeypatch.setattr(tmesh, "world", lambda rank=rank: (rank, 4))
        got.append(tmesh.data_shard(cfg))
    assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]
    monkeypatch.setattr(tmesh, "world", lambda: (0, 3))
    with pytest.raises(ValueError, match="not divisible by model=2"):
        tmesh.data_shard(cfg)
    monkeypatch.setattr(tmesh, "world", lambda: (0, 1))
    assert np.array_equal(tmesh.make_mesh(cfg, devices=list(range(4))).devices,
                          [[0, 1], [2, 3]])


def test_split_dropout_draws_the_whole_activations_mask():
    """A split MLP's dropout (``tp_slice``) keeps, on each model rank, its
    columns of the mask the whole activation draws from the step's
    generator, also on a batch split over the data axis (``rows``)."""
    from multimodal_organ_segmentation_tpu_torch.models.layers import Dropout

    x = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(1))
    drop = Dropout(0.5).train()
    torch.manual_seed(3)
    whole = drop(x)
    for r in range(2):
        drop.tp_slice = (-1, 2, r)
        torch.manual_seed(3)
        assert torch.equal(drop(x[..., 4 * r:4 * r + 4]), whole[..., 4 * r:4 * r + 4])
        mesh = _Mesh(2, r)
        with tmesh.rows(2, 2, 4, mesh):  # this rank's rows 2 and 3 of the batch
            torch.manual_seed(3)
            got = drop(x[2:, :, 4 * r:4 * r + 4])
        assert torch.equal(got, whole[2:, :, 4 * r:4 * r + 4])
